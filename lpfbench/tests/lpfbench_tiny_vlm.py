"""The vision-language cell of ``BENCHMARK.json`` cut to sizes the CPU
runs in seconds, for the tests (the same files, a few sizes changed)."""

from lpfbench import harness

#: the port's ``llava-next-mistral-7b-tower`` smoke config under the
#: configuration file's keys
VLM_SMOKE = dict(
    hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=32, intermediate_size=256,
    vocab_size=512, rope_theta=10000.0,
    vision_config=dict(hidden_size=64, intermediate_size=256,
                       num_hidden_layers=3, num_attention_heads=4,
                       image_size=28, patch_size=14, hidden_act="quick_gelu",
                       layer_norm_eps=1e-5))

CELL = "llava-train-b2s4096-672px"


def vlm_cell(**program_overrides):
    """The cell on the port's tower smoke config (decoder d 128, 2
    layers; tower d 64, 2 run layers of 3, 28-px tiles: 5 tiles and 24
    positions an image), B 2 x S 64 (40 text positions), a pool of 4."""
    cell = harness.load_cell(CELL)
    prog = dict(cell.config["program"], smoke=True, layers=2)
    prog["overrides"] = dict(prog["overrides"], **program_overrides)
    cell.config = dict(cell.config, program=prog,
                       model=dict(cell.config["model"], **VLM_SMOKE),
                       run_as={"image_pinpoint": [56, 56]})
    cell.traffic = dict(cell.traffic, seq=64, pool=4, image_px=[56, 56])
    return cell
