"""repro_torch.sim — the paper's discrete-interval edge simulator (hosts,
network noise, workload arrivals, the container-DAG ``Simulator``), the
port's copy of ``repro.sim`` in numpy."""
