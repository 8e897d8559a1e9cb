"""Framework-neutral system layers: the map-only pipeline, resilience
and the analytic models."""
