"""Multi-device rendering (port of :mod:`pota_tpu.parallel`)."""
