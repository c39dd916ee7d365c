"""Fixture: outside checker/device.py, ops/ and parallel/, syncs are not checked."""


def drain(tensors):
    return [t for t in tensors if t.sum().item()] + [t.tolist() for t in tensors]


def poll(tensors):
    while tensors:
        print(tensors.pop().item())  # clean: service/ is outside the sync scope
