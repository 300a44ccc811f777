"""Timing and provenance helpers of the port."""
