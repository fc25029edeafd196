"""Generators of the inputs: trajectories on a triangle mesh, and the weights."""
