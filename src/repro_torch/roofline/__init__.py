"""The dry-run and roofline layer (port of ``repro.roofline``): the cost
of a step counted on meta tensors (:mod:`.step_cost`), its roofline
terms on the card (:mod:`.analysis`) and the tables of the dry-run's
cells (:mod:`.report`)."""
