"""Per-layer metric readers, one file per metric (``<metric>.py`` exposing
``read(run) -> float | None``; None when the run has nothing to read)."""
