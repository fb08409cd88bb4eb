"""Observability of the port (`hetu_tpu/obs` counterparts): the metrics
registry the serving engine writes into."""
