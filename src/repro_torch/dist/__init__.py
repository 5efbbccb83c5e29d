"""Distributed-training support of the port. Only the fault-tolerance
primitives the trainer needs are here (``dist.fault``); sharding and
collectives wait for ROADMAP Queue 1 item 16."""
