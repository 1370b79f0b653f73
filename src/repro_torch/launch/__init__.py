"""Entry points of the port: the zone mesh (`mesh`), the churn CLIs
(`node_churn`, `failure_churn`), retrieval serving (`serve_retrieval`)
and LM serving (`serve`), each `python -m repro_torch.launch.<name>`."""
