"""Launchers of the port: the training driver (`repro_torch.launch.train`)
on one card.  The reference's mesh construction and multi-pod dry-run
wait for the multi-device slice (ROADMAP A.5)."""
