"""The stacked single-card mesh."""
