"""Card-shards whose posteriors the host computes: 1 - sample_sum
launches / card-shards over the whole traced run (each fused card-shard
launches one ordered per-sample sum; H_pad > 32 is not fused)."""


def read(run):
    shards = run["stats"].get("card_shards", 0)
    if not shards:
        return None
    return 100.0 * (1.0 - run["launches"]["sample_sum"] / shards)
