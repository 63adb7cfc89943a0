"""The cost model of the port's sketch kernels on the H100 (port of
``repro/roofline``): ``hw`` holds the card's constants, ``sketch_model``
the bound and modeled time of one launch, read from a ``Lowering``."""
