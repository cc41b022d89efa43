"""Fits whose cells are split over ranks (``torch.distributed``): the mesh
and the sharded fits (``sharding.py``), the multi-process helpers
(``distributed.py``) and the collectives they use (``collectives.py``).
Counterpart of ``clonealign_tpu/parallel``."""
