"""Launchers of the port, on one card: the training driver
(`repro_torch.launch.train`) and the serving driver
(`repro_torch.launch.serve`).  The reference's mesh construction and
multi-pod dry-run wait for the port's multi-device slice."""
