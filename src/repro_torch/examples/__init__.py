"""The serving examples of the port (twins of the repository's
``examples/*.py``), each a module with ``main(argv=None)``:

  PYTHONPATH=src python -m repro_torch.examples.quickstart --m 800 --epochs 8
  PYTHONPATH=src python -m repro_torch.examples.serve_batched
  PYTHONPATH=src python -m repro_torch.examples.serve_online
  PYTHONPATH=src python -m repro_torch.examples.serve_fleet
  PYTHONPATH=src python -m repro_torch.examples.lifecycle_refresh

Each runs on the card and raises without one unless ``--device cpu`` is
passed.  Importing them builds nothing and opens no process group."""
