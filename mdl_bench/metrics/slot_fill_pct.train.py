"""Real edges over edge slots of every batch of the traced training window
(train and val), from the batch spec and the corpus's counts."""


def read(record):
    if record.get("kind") != "train" or not record.get("edge_slots"):
        return None
    real = record["train_counts"][1] + record["val_counts"][1]
    return 100.0 * real / record["edge_slots"]
