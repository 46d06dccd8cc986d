"""Arguments of the extraction command line (cli/extractor.py)."""

import argparse


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="wesep_tpu_torch target speaker extraction")
    parser.add_argument("audio_file", help="mixture wav")
    parser.add_argument("audio_file2", help="enrollment wav")
    parser.add_argument("-t", "--task", default="extraction",
                        choices=["extraction"])
    parser.add_argument("-l", "--language", default="english",
                        choices=["english", "chinese"])
    parser.add_argument("-p", "--pretrain", default="",
                        help="local model dir (config.yaml + avg_model.ckpt)")
    parser.add_argument("-o", "--output_file", default="extracted.wav")
    parser.add_argument("--vad", action="store_true",
                        help="energy-VAD trim the enrollment")
    parser.add_argument("--resample_rate", type=int, default=None)
    parser.add_argument("--output_norm", action="store_true", default=True)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)
