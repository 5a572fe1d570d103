"""Training and sharding: the train step (on one device or over a mesh),
the Sharder's rules, the collectives of the sharded path and fault
handling (own copies of `repro/distributed/`)."""
