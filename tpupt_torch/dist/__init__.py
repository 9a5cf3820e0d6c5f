"""Row-band sharding of renders over a ``torch.distributed`` group."""
