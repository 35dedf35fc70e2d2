"""Distributed pieces of the port: the halo-exchange geometry and the LP
collectives across the ranks of a ``torch.distributed`` group
(``collectives.LPGroup``, ``collectives.halo_exchange``)."""
