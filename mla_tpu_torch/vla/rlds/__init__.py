"""The RLDS robot-data pipeline without TensorFlow: the TFDS-layout reader
and writer, PNG and JPEG, the trajectory and frame transforms, and the
interleaved frame stream the trainer reads."""
