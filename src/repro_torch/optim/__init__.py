"""Learning-rate schedules (counterpart of ``repro.optim``)."""
