"""The SRmeetsPS model: problem, state and the alternating estimators."""
