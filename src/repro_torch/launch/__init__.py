"""repro_torch.launch — entry points of the runtime.

  serve.py  batched serving: the planner's plan, then prefill + greedy
            decode with a KV cache (``python -m repro_torch.launch.serve``)
"""
