"""Distributed-optimization helpers (the int8 gradient compression the
train step uses; the all-reduce and sharding rules come with the
distribution slice)."""
