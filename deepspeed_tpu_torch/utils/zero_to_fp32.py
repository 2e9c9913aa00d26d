"""Offline ZeRO checkpoint -> consolidated fp32 state dict (counterpart of
``deepspeed_tpu/utils/zero_to_fp32.py``; reference
deepspeed/utils/zero_to_fp32.py).

Rebuilds the full fp32 parameters from the ``zero_pp_rank_*`` shard files
of a tag written by either engine, without an engine or a device: one
file a rank (each holding its boxes of the masters: its slices at stage
3, whose model states hold no ``module``) or one file of every device's
shards. The shards carry their global indices
(``runtime/checkpoint_io.py``), so the result does not depend on the
world size that wrote them. Keys are the
JAX key paths of the tag (``['h_0']['attn']['qkv']['kernel']`` for a
model family the two packages share, ``['<state_dict name>']`` for a user
module); values are numpy arrays in the saved layout. As a library or::

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint_dir> <output>
"""

import argparse
import glob
import os
import pickle
import re

from deepspeed_tpu_torch.runtime.checkpoint_io import assemble


def get_latest_tag(checkpoint_dir):
    """The tag ``latest`` names, else the last tag directory in natural
    order (``global_step10`` after ``global_step9``)."""
    latest = os.path.join(checkpoint_dir, "latest")
    if os.path.isfile(latest):
        with open(latest) as f:
            return f.read().strip()

    def natural(t):
        return [int(x) if x.isdigit() else x for x in re.split(r"(\d+)", t)]

    tags = sorted((d for d in os.listdir(checkpoint_dir)
                   if os.path.isdir(os.path.join(checkpoint_dir, d))),
                  key=natural)
    if not tags:
        raise FileNotFoundError(f"no checkpoint tags under {checkpoint_dir}")
    return tags[-1]


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=None):
    """``{param key path: np.ndarray fp32}`` of the tag (default: the
    latest)."""
    if tag is None:
        tag = get_latest_tag(checkpoint_dir)
    ckpt_dir = os.path.join(checkpoint_dir, str(tag))
    zero_files = sorted(glob.glob(
        os.path.join(ckpt_dir, "zero_pp_rank_*_optim_states.pt")))
    if not zero_files:
        raise FileNotFoundError(f"no zero_pp_rank files in {ckpt_dir}")
    payloads = []
    for path in zero_files:
        with open(path, "rb") as f:
            payloads.append(pickle.load(f)["param_shards"])
    return assemble(payloads)


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir, output_file,
                                               tag=None):
    """Write the consolidated dict to ``output_file`` (a pickle)."""
    state_dict = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    with open(output_file, "wb") as f:
        pickle.dump(state_dict, f)
    print(f"saved {len(state_dict)} tensors to {output_file}")
    return state_dict


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint_dir")
    parser.add_argument("output_file")
    parser.add_argument("-t", "--tag", default=None)
    args = parser.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(
        args.checkpoint_dir, args.output_file, tag=args.tag)


if __name__ == "__main__":
    main()
