"""SFNO training: losses, the train/eval pipeline and the CLI."""
