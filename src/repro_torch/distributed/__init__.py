"""Distributed pieces of the port.  So far only the halo-exchange
geometry (``collectives.halo_spec``); the collectives are ROADMAP
Queue 1 item 6."""
