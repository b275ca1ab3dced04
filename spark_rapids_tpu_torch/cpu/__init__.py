"""The host engine: plan nodes run by the port's own execs on the CPU."""
