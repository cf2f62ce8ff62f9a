"""SkyStore in PyTorch for NVIDIA Hopper: the port of the JAX package ``repro``.

The port mirrors ``repro``'s layout, so each module's counterpart is found
by path (``repro_torch.core.simulator`` <-> ``repro.core.simulator``).  It
imports torch, numpy and the standard library, never JAX and nothing of
``repro``.  Its entry points run their kernels on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.

  core     -- the cost plane of adaptive-TTL placement: cost model,
              histograms, TTL controller, policies, event spine, simulator
  kernels  -- the hand-written CUDA kernels for sm_90a, their plain PyTorch
              versions, and the wrappers that choose between them
  configs  -- the model configurations (a verbatim copy of the reference's)
  models   -- the transformer stack of the dense attention families
  serve    -- prefill / decode steps and the adaptive-TTL KV tier
  launch   -- ``python -m repro_torch.launch.serve``, the serving driver
"""
