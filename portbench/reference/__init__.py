"""The plain reference: FLUID-LLM in float32 PyTorch, its data layer, and the comparison
that decides `correct`.  Imports nothing of the port."""
