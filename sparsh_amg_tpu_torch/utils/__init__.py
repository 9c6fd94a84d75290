"""Device-memory accounting."""
