"""ResNet-50 training on synthetic data, on one card.

Counterpart of examples/scripts/train_resnet.py, with its flags and its
printed line.  Run as::

    python -m skypilot_tpu_torch.train.train_resnet --steps 100 \\
        --batch-size 256 --image-size 224 [--device cpu]

The images are ones (bf16, NHWC) and every label 0, as in the reference;
the update is optax.sgd(0.1, momentum=0.9)'s (trace = g + 0.9 trace,
p -= 0.1 trace), which is torch.optim.SGD's with momentum 0.9 and no
dampening.  One warm-up step, then ``--steps`` timed steps.  The run is on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.nn.functional as F

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import resnet


def make_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """One training step: the loss (softmax CE with integer labels, mean)
    of a train-mode forward, which moves the running statistics; its
    gradients; the optimizer's update.  Returns the loss tensor."""
    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def sgd(model: torch.nn.Module) -> torch.optim.Optimizer:
    """optax.sgd(0.1, momentum=0.9)."""
    return torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--batch-size', type=int, default=1024)
    parser.add_argument('--image-size', type=int, default=224)
    parser.add_argument('--device', default=None,
                        help='default: the CUDA card')
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    device = resolve_device(args.device)
    torch.manual_seed(0)
    model = resnet.ResNet50().to(device)
    step = make_step(model, sgd(model))
    images = torch.ones((args.batch_size, args.image_size, args.image_size,
                         3), dtype=torch.bfloat16, device=device)
    labels = torch.zeros((args.batch_size,), dtype=torch.long, device=device)
    loss = step(images, labels)               # warm-up
    float(loss)
    start = time.perf_counter()
    for _ in range(args.steps):
        loss = step(images, labels)
    final = float(loss)                        # waits for the last step
    elapsed = time.perf_counter() - start
    ips = args.batch_size * args.steps / elapsed
    print(f'images/sec: {ips:.1f} ({ips:.1f}/chip), final loss {final:.4f}')


if __name__ == '__main__':
    main()
