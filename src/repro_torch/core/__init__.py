"""The paper's technique at LM scale, on the port's counts."""
