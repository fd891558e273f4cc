"""Command-line apps of the port: dtx-convert
(python -m detex_tpu_torch.cli.convert) and dtx-train
(python -m detex_tpu_torch.cli.train)."""
