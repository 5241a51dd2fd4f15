"""Host utilities: configuration enums, phase tracing, residual gates, interop."""
