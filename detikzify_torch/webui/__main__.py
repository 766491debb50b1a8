"""CLI entry: ``python -m detikzify_torch.webui`` (counterpart of the JAX
package's ``webui/__main__.py``; reference
``detikzify/webui/__main__.py:6-52``)."""
import argparse

from .strings import ALGORITHMS, MODELS
from .webui import build_ui


def parse_args():
    parser = argparse.ArgumentParser(
        description="DeTikZify web UI (PyTorch/CUDA)")
    parser.add_argument("--model", default=next(iter(MODELS)),
                        choices=list(MODELS),
                        help="initially selected model")
    parser.add_argument("--algorithm", default="mcts",
                        choices=list(ALGORITHMS),
                        help="initially selected inference algorithm")
    parser.add_argument("--lock", action="store_true",
                        help="lock model selection (serializes runs)")
    parser.add_argument("--lock_reason",
                        default="Duplicate this space to be able to "
                                "change this value.",
                        help="why model selection is locked")
    parser.add_argument("--share", action="store_true",
                        help="create a public gradio link")
    parser.add_argument("--light", action="store_true",
                        help="force light theme")
    parser.add_argument("--speculate", type=int, default=0,
                        help="n-gram speculative decoding draft length")
    parser.add_argument("--device", default="cuda",
                        help="device of the loaded model ('cpu' runs the "
                             "kernels' plain versions)")
    parser.add_argument("--timeout", type=int, default=60,
                        help="LaTeX compile timeout in seconds (the MCTS "
                             "budget is the UI Timeout slider, in minutes)")
    return parser.parse_args()


def main():
    args = parse_args()
    demo = build_ui(model=args.model, algorithm=args.algorithm,
                    lock=args.lock, lock_reason=args.lock_reason,
                    light=args.light, timeout=args.timeout,
                    speculate=args.speculate, device=args.device)
    demo.queue().launch(share=args.share)


if __name__ == "__main__":
    main()
