"""Traffic drivers, one file per kind (``<driver>.py`` exposing ``drive(run)``)."""
