# Import submodules directly (repro_torch.objectstore.store / .latency / .client);
# keeping this empty avoids a store->stragglers->latency import cycle.
