"""Timing probes of the port: A/B runs of one kernel against the path it
replaces, on the card. Nothing runs on import."""
