"""Algorithms: cholinv."""
