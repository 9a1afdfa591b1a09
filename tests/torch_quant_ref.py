"""Float64 references of the JAX package's QAT training, for
tests/test_torch_quantization.py.

    python tests/torch_quant_ref.py IN.npz OUT.npz

IN.npz holds a state dict (`sd/<key>`), `QAT_STEPS` input batches
(`x<i>`) and labels (`y<i>`). The script builds `qat_net` with the JAX
package, wraps it with `ImperativeQuantAware().quantize`, loads the
state dict, casts it to float64 (x64 enabled) and trains it
`QAT_STEPS` Momentum steps in the JAX `jit.TrainStep`; OUT.npz holds the
losses and the state dict after them. The port (float32: it has no
float64) is held against this float64 run: in float32 on both sides a
rounding to the int8 grid can flip where the two packages' float32
products differ in their last bit. x64 is a process-wide JAX setting,
so the reference runs in a process of its own. Importing this module
touches no JAX setting.
"""
import sys

import numpy as np

QAT_STEPS = 3
QAT_LR, QAT_MOMENTUM = 0.05, 0.9


def qat_net(P):
    """A small conv net of `P`'s layers (either package): [B, 3, 8, 8]
    images to 5 logits."""
    nn = P.nn
    return nn.Sequential(nn.Conv2D(3, 4, 3), nn.ReLU(), nn.Conv2D(4, 6, 3,
                                                                  stride=2),
                         nn.ReLU(), nn.Flatten(), nn.Linear(6 * 2 * 2, 5))


def main(in_path, out_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import paddle_tpu as pj
    from paddle_tpu.jit import TrainStep
    from paddle_tpu.quantization import ImperativeQuantAware

    blobs = dict(np.load(in_path))
    model = ImperativeQuantAware().quantize(qat_net(pj))
    sd = {k[3:]: v for k, v in blobs.items() if k.startswith("sd/")}
    assert model.set_state_dict(sd) == ([], [])
    model.to(dtype="float64")
    opt = pj.optimizer.Momentum(learning_rate=QAT_LR, momentum=QAT_MOMENTUM,
                                parameters=model.parameters())
    step = TrainStep(model, lambda out, y: pj.nn.functional.cross_entropy(
        out, y), opt)
    losses = []
    for i in range(QAT_STEPS):
        losses.append(np.asarray(step(
            (pj.to_tensor(blobs[f"x{i}"], dtype="float64"),),
            (pj.to_tensor(blobs[f"y{i}"]),)).numpy()))
    step.sync()                 # the trained state back into the model
    out = {"losses": np.stack(losses)}
    for k, v in model.state_dict().items():
        out[f"sd/{k}"] = np.asarray(v.numpy())
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
