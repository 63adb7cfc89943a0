"""Training substrate (port of ``repro.train``): the step builder, the trainer loop, checkpointing."""
