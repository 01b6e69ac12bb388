"""Measurement tools of the PyTorch port (``python -m raft_stereo_tpu_torch.tools.<name>``)."""
