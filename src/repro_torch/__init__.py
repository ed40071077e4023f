"""PyTorch/CUDA port of the ThinKV serving system (the JAX package
``repro`` is the reference it is held against).

Layout mirrors ``repro``: ``core`` (quantization, thoughts, k-means,
retention policy, CT paged cache), ``kernels`` (hand-written CUDA kernels
for Hopper with their plain PyTorch versions), ``layers``, ``models``,
``serving`` (scheduler, engine, sampling and its PRNG, prefix cache,
orchestrator), ``training`` (AdamW, the train step, the trainer),
``checkpoint``, ``ft`` (failure injection, straggler monitor), ``data``
and ``launch``.  The package imports ``torch`` and numpy only.
"""
