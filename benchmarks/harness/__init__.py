"""What every loop shares: cells found by name, traffic, the trace, the result line."""
