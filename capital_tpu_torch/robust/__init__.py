"""Breakdown detection, fault injection and the shifted-CholeskyQR recovery ladder."""
