"""Scoring functions (torch)."""
