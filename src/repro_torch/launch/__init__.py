"""Entry points of the port: the zone mesh (`mesh`) and the churn CLIs
(`node_churn`, `failure_churn`), each `python -m repro_torch.launch.<name>`."""
