"""What the harness shares: the spec, the device, the trace, the peaks and the counts."""
