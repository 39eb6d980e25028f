"""Index metadata and administration: aliases, index templates, settings,
close / open and resize (copies of opensearch_tpu/cluster/state.py and
cluster/admin.py, over the port's client)."""
