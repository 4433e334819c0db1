"""One module per model family: the reference forward it uses, its
parameter shapes, and how its seeded weights become the port's encoder
(``TextEncoder`` over the family's module, as ``models.registry.load_encoder``
builds it, with the state dict handed over in memory)."""
