"""Step builders of the LM zoo (the train step with microbatched gradient
accumulation, remat and the clipped update; the serving steps), their input
specs and cells on a mesh, production meshes, and the dry run."""
