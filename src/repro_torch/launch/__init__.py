"""Entry points (counterpart of ``repro.launch``): ``serve`` generates from
an LM."""
