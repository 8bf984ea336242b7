"""The plain reference (`decoder.py`, `optim.py`) and the control
(`lowp.py`).  Plain torch; imports nothing of the program."""
