"""Training of the port: AdamW and the train step."""
