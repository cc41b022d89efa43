"""Device selection and the float32 matmul precision policy.

The public entry points of the port take ``device="cuda"`` by default and
``"cpu"`` when asked. There is no automatic choice: ``"cuda"`` on a machine
without a usable GPU raises instead of running on the CPU.

Precision policy (the counterpart of the per-contraction policy in
``clonealign_tpu/models/multinomial.py``): on an NVIDIA card a float32
``torch.matmul`` may run in TF32, which keeps about three decimal digits.
The port's float32 products outside the kernels — the PCA initialization
and the per-clone count sums of ``compute_correlations`` — run inside
:func:`full_fp32_matmul`, which turns TF32 off for matmuls and cuDNN and
restores the previous setting afterwards. The likelihood kernels themselves
run their products with the exp on tensor cores as three TF32 products of
split operands (3xTF32, hi*hi + hi*lo + lo*hi), summed outside the tensor
cores, which keeps float32 accuracy; their sums over Y are float32 on CUDA
cores. A float64 fit runs every product in float64 (TF32 touches float32
only), its likelihood in the float64 kernel family.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """The torch.device for an explicit ``device`` argument ("cpu", "cuda",
    "cuda:1" or a torch.device). Raises when a CUDA device is asked for and
    none is available, and when no device is given."""
    if device is None:
        raise ValueError("device must be given explicitly: 'cpu' or 'cuda'")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was requested but torch.cuda.is_available() "
                "is false"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device={str(device)!r} was requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cpu' or a CUDA device, got {device!r}")
    return dev


def resolve_dtype(dtype: str, device: torch.device) -> torch.dtype:
    """The compute dtype, on either device: on CUDA float32 runs the
    float32 likelihood kernels and float64 their float64 family
    (``ops/csrc/fused_likelihood_f64.cu``). ``device`` is taken for the
    entry points' one call shape."""
    del device
    dt = {"float32": torch.float32, "float64": torch.float64}.get(dtype)
    if dt is None:
        raise ValueError(f"dtype must be 'float32' or 'float64', got {dtype!r}")
    return dt


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU), so a host
    clock read after it times finished work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def full_fp32_matmul():
    """Run float32 matmuls and convolutions without TF32 inside the block."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
