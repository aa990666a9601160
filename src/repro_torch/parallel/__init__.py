"""Distribution of the port over ``torch.distributed`` (port of
``repro/parallel``): sharding rules, the expert-parallel MoE plane, and
the analytic pipeline-stage plan (``pipeline``)."""
