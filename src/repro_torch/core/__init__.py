"""Plan compilation, costs and the stacked two-stage shuffle."""
