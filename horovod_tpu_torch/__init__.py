"""horovod_tpu_torch: the PyTorch + CUDA port of ``horovod_tpu``.

A second package beside the JAX one, written in PyTorch for an NVIDIA
H100.  Its module layout mirrors ``horovod_tpu`` so each module's
counterpart is found under the same path; inside, it is PyTorch idiom
(``nn.Module``s, explicit ``device`` and ``torch.Generator``).  Every
kernel the JAX package wrote in Pallas for the TPU becomes a kernel
written by hand for Hopper (``csrc/``), built at first use.

This package imports ``torch`` and numpy only — never ``jax`` and
nothing of ``horovod_tpu``; it keeps its own copies of the jax-free
helpers it needs.

Ported so far (the serving slice): ``serving`` (paged KV cache,
continuous batching, chunked prefill, prefix cache) over
``models.transformer`` and the paged flash-attention kernel in
``ops.flash_attention``.  Entry points run on the card unless the
caller passes ``device="cpu"``; without a card and without that
explicit choice they raise.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
