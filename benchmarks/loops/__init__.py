"""One module a kind of traffic: ``run`` (one benchmark run) and ``calibrate`` (readings for the limits)."""
