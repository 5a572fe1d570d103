"""Training on one device: the train step and fault handling (own copies
of `repro/distributed/`; the sharded pieces wait for ROADMAP section 1,
item 8)."""
