"""Training over several processes, one per GPU: the process group, the
('data', 'model') mesh, its placement rules and the model-region
collectives (``mesh.py``)."""
