"""repro_torch — the MiniConv split-policy system, and the split-served
LLM path, in PyTorch and CUDA.

A port of the JAX/Pallas package ``repro`` (which stays the reference) to
PyTorch with kernels written by hand in CUDA C++ for Hopper (``sm_90a``).
Module names follow the reference, so each counterpart is found under the
same path: ``repro_torch.deploy`` beside ``repro.deploy``, and so on.

Layout rules kept from the reference: activations are NHWC and conv
kernels HWIO at every public function; any NCHW is internal.

Device rule: every entry point defaults to ``"cuda"`` and raises when CUDA
is absent.  Only an explicit ``device="cpu"`` runs on the CPU, where the
kernel wrappers use their plain PyTorch versions.
"""
