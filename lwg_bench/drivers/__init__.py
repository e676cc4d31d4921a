"""One driver per kind of traffic (the ``driver`` key of a traffic
file): set-up, the measured window, the traced stretch and the check of
what the window produced."""
