"""Continuous-batching LM serving, the port of ``pytorch_distributed_tpu/serving``.

A paged KV cache (kvpool), admission/preemption scheduling (scheduler), the
step loop with its decode step captured once as a CUDA graph and its
``trace``/``watchdog``/``chaos`` hooks (engine), the paged twin of the LM
(model) and a seeded synthetic load harness (loadgen), fronted by
``python -m pytorch_distributed_tpu_torch.serving.serve_lm``; and the fleet:
the replica server over the engine or a torch-free sim (replica) and the
health-checked, exactly-once router with its arbiter (router), driven by
``tools/serve_fleet.py`` and ``tools/chaoskit.py``'s drills.

This ``__init__`` imports nothing, so the router and the sim replicas load
without torch.
"""
