"""The one source of every random draw of a fit.

A fit draws standard normals in a fixed order: the PCA test matrix
(``"pca_omega"``), the psi jitter (``"psi_jitter"``), the warm-start sample
(``"warm"``), the initial ELBO sample (``"init_eval"``), per iteration the
training sample (``"train"``) and, with ``elbo_eval="fresh"``, the
monitoring sample (``"eval"``), and the final ELBO samples (``"final"``).
Each draw names what it is for, so a test can subclass :class:`Noise` and
hand the port the draws another program made in the same places.
"""

from __future__ import annotations

import torch


class Noise:
    """Standard normals from one seeded ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=torch.device(device))
        self.generator.manual_seed(int(seed))

    def normal(self, what: str, shape, dtype: torch.dtype, device) -> torch.Tensor:
        del what  # every draw comes from the same stream, in call order
        return torch.randn(
            tuple(shape), generator=self.generator, dtype=dtype, device=device
        )
