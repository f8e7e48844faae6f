"""The HOP-DDP solver: cost, linearization, select, backward, line search, outer loop."""
