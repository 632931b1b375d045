"""repro_torch.dist — distribution substrate, the port of the reference's
``repro.dist``: logical sharding on DTensor, roofline terms of a traced
step, and compression.

    context.mesh_rules / context.constrain   — logical-axis sharding context
    sharding.ShardingRules / spec_for        — logical axes -> spec entries
    sharding.placements_for                  — spec entries -> DTensor placements
    hlo_analysis.collective_stats / Roofline — roofline terms of a traced step
    compression.quantize_int8 / int8_allreduce_mean — int8 gradient traffic
    compression.encode_bytes / decode_bytes  — the arena store's byte codec
"""
