"""Timing helpers of the port."""
