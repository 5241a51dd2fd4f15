"""Device topology and the single-device SUMMA routes."""
