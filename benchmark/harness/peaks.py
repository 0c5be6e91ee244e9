"""Published peaks of the card the benchmark runs on (NVIDIA's H100 SXM
data sheet, dense rates, at the full 700 W power limit)."""

H100 = dict(
    hbm_bytes_per_s=3.35e12,
    fp32_flops_per_s=67e12,
    fp64_flops_per_s=34e12,
    int32_ops_per_s=16.75e12,
    memory_bytes=80e9,
)
