"""MPNN's message-passing layers as the model runs them: each layer's edge
network and NNConv (the model's _message), the Gaussian basis formed once."""


def layers(model, batch):
    def run(x):
        e = model.edge_features(batch)
        return [model._message(i, x, batch, e) for i in range(model.gc_count)]
    return run
