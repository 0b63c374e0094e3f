"""Step builders of the LM zoo (the serving steps; training steps are not
ported yet)."""
