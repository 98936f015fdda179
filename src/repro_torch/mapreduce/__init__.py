"""The MapReduce engine and its jobs."""
