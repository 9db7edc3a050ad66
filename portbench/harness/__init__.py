"""What every cell shares: loading a cell by name, the card, the data
recipes, the traced window, the yardstick's arithmetic, the import guard."""
