"""Architecture configs of the port (twins of ``repro/configs/*``, value for
value).  The five LM configs are here; the registry, the recsys and GNN
configs and ``lemur_paper`` wait for the next slice (ROADMAP Queue 1 item
10(b))."""
