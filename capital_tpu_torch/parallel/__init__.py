"""Device topology, the in-process mesh and the SUMMA schedules."""
