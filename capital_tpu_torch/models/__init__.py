"""Algorithms: cholinv and CholeskyQR2."""
