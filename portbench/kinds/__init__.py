"""How each kind of traffic drives the program: `train.py`, `prefill.py`
(the traffic file's `kind`)."""
