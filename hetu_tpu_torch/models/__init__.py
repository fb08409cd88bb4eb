"""Model families of the port (`hetu_tpu/models` counterparts) and the
serving forwards in `generation`."""
