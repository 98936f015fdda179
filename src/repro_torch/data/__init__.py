"""The port's data pipeline."""
