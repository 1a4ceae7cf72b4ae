"""Synthetic serving workloads (the reference's ``repro.data.workload``)."""
