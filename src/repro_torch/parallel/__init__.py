"""Distribution of the port over ``torch.distributed`` (port of
``repro/parallel``): sharding rules and the expert-parallel MoE plane."""
