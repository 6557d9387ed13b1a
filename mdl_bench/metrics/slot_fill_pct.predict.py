"""Real edges over edge slots of every batch of the traced Predict window,
from the batch spec and the corpus's counts."""


def read(record):
    if record.get("kind") != "predict" or not record.get("edge_slots"):
        return None
    return 100.0 * record["predict_counts"][1] / record["edge_slots"]
