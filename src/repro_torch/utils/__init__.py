"""Helpers that stand apart from the model and the datapath: ``report``, a
copy of :mod:`repro.utils.report` (the markdown tables of the pool, qos,
scheduler, trace, health and workload summaries)."""
