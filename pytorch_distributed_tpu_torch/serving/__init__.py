"""Continuous-batching LM serving, the port of ``pytorch_distributed_tpu/serving``.

A paged KV cache (kvpool), admission/preemption scheduling (scheduler), the
step loop with its decode step captured once as a CUDA graph (engine), the
paged twin of the LM (model) and a seeded synthetic load harness (loadgen),
fronted by ``python -m pytorch_distributed_tpu_torch.serving.serve_lm``.
The replica server and the router wait for ROADMAP.md item A12.
"""
