"""Step builders of the LM zoo: the train step (microbatched gradient
accumulation, remat, clipped update) and the serving steps."""
