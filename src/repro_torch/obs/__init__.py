"""Tracing spans, metrics and rack-byte accounting used by the engine."""
