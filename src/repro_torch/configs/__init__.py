"""Architecture configs of the port (twins of ``repro/configs/*``, value for
value): the five LM configs, the four recsys configs, meshgraphnet and the
paper's own ``lemur_paper``; ``registry`` maps ``--arch`` ids to them."""
