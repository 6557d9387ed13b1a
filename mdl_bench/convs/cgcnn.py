"""CGCNN's message-passing layers as the model runs them: conv{i}(x, batch,
edge_attr), the Gaussian basis formed outside the layers except on a batch
of the fused plan, whose kernel forms it."""


def layers(model, batch):
    def run(x):
        e = None if batch.kernel_fused else model.edge_features(batch)
        return [getattr(model, f"conv{i}")(x, batch, e)
                for i in range(model.gc_count)]
    return run
