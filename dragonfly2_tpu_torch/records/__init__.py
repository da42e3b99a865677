"""Trace records, their synthetic generator, and feature extraction."""
