"""Lens prescriptions of the port (:mod:`pota_tpu_torch.lens.database`)."""
