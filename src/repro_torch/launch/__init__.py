"""repro_torch.launch — entry points of the runtime.

  serve.py  batched serving: the planner's plan, then prefill + greedy
            decode with a KV cache (``python -m repro_torch.launch.serve``)
  train.py  training: the planner's plan, the synthetic data pipeline,
            loss + gradient through the kernels, AdamW, checkpoints
            (``python -m repro_torch.launch.train``)
"""
