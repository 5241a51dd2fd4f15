"""Breakdown detection."""
