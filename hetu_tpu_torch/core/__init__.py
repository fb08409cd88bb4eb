"""Core host-side helpers of the port (the counterpart of
`hetu_tpu/core`): the dtype policy (`dtypes`)."""
